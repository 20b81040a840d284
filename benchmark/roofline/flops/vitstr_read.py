"""ViTSTR's read, FLOPs an image: the patch projection, the encoder over the
patches and the class token, the head over max_label_length + 1 tokens. The
CPU tests hold it to FlopCounterMode on the reference."""

from roofline import macs


def flops(cfg, ids):
    N, pin = macs.patches(cfg)
    D = cfg['embed_dim']
    return 2.0 * (N * pin * D + macs.vit(cfg, N + 1, cfg['depth'])
                  + (cfg['max_label_length'] + 1) * D * ids.num_classes)
