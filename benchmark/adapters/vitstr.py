"""The program's side of ViTSTR for the drivers: one parallel read (no AR
pass to record), and its encoder's blocks."""

AR_ENTRIES = None
wrap_ar = None


def encoder_blocks(bundle):
    return bundle.module.blocks
