"""ABINet's read, FLOPs an image (two a multiply-accumulate): ResNet45, the
transformer layers over the (H / 4) x (W / 4) feature positions, position
attention (its U-Net's convolutions, the queries' projection, scores and
weighted sum), the vision classifier, then `iter_size` times the language
model (the probabilities' projection, decoder layers of cross-attention and
MLP, classifier) and the alignment (gate and classifier). The CPU tests
hold it to FlopCounterMode on the reference."""


def _conv_out(h, w, sh, sw):
    """Output size of a 3x3 convolution (padding 1) or a 1x1 one (no
    padding) at strides (sh, sw): both ceil(size / stride)."""
    return (h - 1) // sh + 1, (w - 1) // sw + 1


def resnet45(h, w):
    """MACs of ResNet45 on an (h, w) crop of 3 channels."""
    macs, cin = 32 * 3 * 9 * h * w, 32
    for planes, n, stride in zip((32, 64, 128, 256, 512), (3, 4, 6, 6, 3), (2, 1, 2, 1, 1)):
        for bi in range(n):
            s = stride if bi == 0 else 1
            c = cin if bi == 0 else planes
            macs += planes * c * h * w  # 1x1 conv1 at the input's size
            oh, ow = _conv_out(h, w, s, s)
            macs += planes * planes * 9 * oh * ow  # 3x3 conv2 with the stride
            if bi == 0 and (s != 1 or c != planes):
                macs += planes * c * oh * ow  # the 1x1 projection of the input
            h, w = oh, ow
        cin = planes
    return macs


def position_attention(h, w, E, T, channels=64):
    """MACs of position attention on an (h, w) map of E channels: the
    U-Net's four strided convolutions, three after x2 upsamplings and the
    last back to E channels at (h, w); the queries' projection, the scores
    and the weighted sum of the values."""
    macs, kh, kw, c = E * channels * 9 * h * w + T * E * E + 2 * T * h * w * E, h, w, E
    for stride in ((1, 2), (2, 2), (2, 2), (2, 2)):
        kh, kw = _conv_out(kh, kw, *stride)
        macs += channels * c * 9 * kh * kw
        c = channels
    for _ in range(3):
        kh, kw = 2 * kh, 2 * kw
        macs += channels * channels * 9 * kh * kw
    return macs


def flops(cfg, ids):
    (H, W), E, Fd = cfg['img_size'], cfg['d_model'], cfg['d_inner']
    T, C = cfg['max_label_length'] + 1, ids.num_classes
    h, w = H // 4, W // 4
    L = h * w
    vision = (resnet45(H, W)
              + cfg['v_num_layers'] * (4 * L * E * E + 2 * L * L * E + 2 * L * E * Fd)
              + position_attention(h, w, E, T) + T * E * C)
    language = T * C * E + cfg['l_num_layers'] * (4 * T * E * E + 2 * T * T * E
                                                  + 2 * T * E * Fd) + T * E * C
    align = T * 2 * E * E + T * E * C
    return 2.0 * (vision + cfg['iter_size'] * (language + align))
