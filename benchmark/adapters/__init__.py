"""The program's side of each model, one file a configuration names by its
`adapter` key: `AR_ENTRIES` and `wrap_ar(bundle, on_logits)` (the entries
its AR pass runs through, wrapped so each call hands over its logits; None
for a model without one) and `encoder_blocks(bundle)`."""
