"""PARSeq's read, FLOPs an image (two a multiply-accumulate): the encoder,
the AR pass (teacher-forced: one parallel pass) and one refinement, each
decode over the max_label_length + 1 positions. The CPU tests hold it to
FlopCounterMode on the reference."""

from roofline import macs


def flops(cfg, ids):
    assert cfg['dec_depth'] == 1
    N, pin = macs.patches(cfg)
    n = cfg['max_label_length'] + 1
    return 2.0 * (N * pin * cfg['embed_dim'] + macs.vit(cfg, N, cfg['enc_depth'])
                  + 2 * macs.decode(cfg, n, N, ids.num_classes))
