"""The port's model-loading tools: certify_pretrained (released weights
against the reference's demo fixtures) and abinet_lm_acc (ABINet's
language model alone on ground truth), counterparts of tools/*.py."""
