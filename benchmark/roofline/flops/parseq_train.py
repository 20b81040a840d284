"""PARSeq's training step, FLOPs an image: forward and backward of the
multi-permutation loss: the encoder once, the memory's keys and values
once, a decode for each permutation; the backward twice the forward's
products (input and weight gradients), less the input gradient of the
patch projection, which the images do not need. The CPU tests hold it to
FlopCounterMode on the reference."""

from roofline import macs


def flops(cfg, ids):
    assert cfg['dec_depth'] == 1
    N, pin = macs.patches(cfg)
    D, n, K = cfg['embed_dim'], cfg['max_label_length'] + 1, cfg['perm_num']
    patch = N * pin * D
    fwd = (patch + macs.vit(cfg, N, cfg['enc_depth']) + N * D * 2 * D
           + K * macs.decode(cfg, n, N, ids.num_classes, memory_kv=False))
    return 2.0 * (3 * fwd - patch)
