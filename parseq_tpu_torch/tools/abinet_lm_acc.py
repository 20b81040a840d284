"""ABINet language-model word accuracy given ground truth as input (port of
tools/test_abinet_lm_acc.py; reference tools/test_abinet_lm_acc.py:22-111).

Feeds one-hot ground-truth labels into the BCN language model alone
(models/abinet.py:ABINet.language_forward, f32) and reports how often it
reproduces the word: the LM apart from the vision model. Prints each
split's running accuracy and the final `LM word accuracy: x% (c/t)` line.

Usage:
    python -m parseq_tpu_torch.tools.abinet_lm_acc CHECKPOINT --data_root data
        [--splits test/IIIT5k ...] [--batch_size 256] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F


def batch_probs(model, labels, batch_size=256):
    """Yields (labels, probabilities (B, max_length, num_classes) numpy) for
    each batch of `labels`: the language model's softmax with each label fed
    in as one-hot ground truth (NULL past its end), from a loaded ABINet
    bundle."""
    cfg, tok, device = model.cfg, model.tokenizer, model.device
    abinet = model.module.eval()
    for i in range(0, len(labels), batch_size):
        batch = labels[i:i + batch_size]
        enc = tok.encode(batch, cfg.max_label_length)[:, 1:]  # drop BOS
        enc = enc[:, :cfg.max_length]
        targets = np.where(enc == cfg.pad_id, cfg.null_label, enc)
        onehot = F.one_hot(torch.from_numpy(targets).long().to(device), cfg.num_classes).float()
        lengths = torch.tensor([len(label) + 1 for label in batch], device=device)
        with torch.inference_mode():
            logits = abinet.language_forward(onehot, lengths)['logits']
        yield batch, torch.softmax(logits.float(), -1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('checkpoint')
    ap.add_argument('--data_root', default='data')
    ap.add_argument('--splits', nargs='+',
                    default=['test/IIIT5k', 'test/SVT', 'test/SVTP', 'test/IC13_1015',
                             'test/IC15_2077', 'test/CUTE80'])
    ap.add_argument('--batch_size', type=int, default=256)
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    args = ap.parse_args(argv)

    from parseq_tpu_torch.data.dataset import LmdbDataset
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    model = load_from_checkpoint(args.checkpoint, dtype=torch.float32, device=args.device)
    total = correct = 0
    for split in args.splits:
        labels = LmdbDataset(os.path.join(args.data_root, split),
                             model.raw_config['charset_train'], model.cfg.max_label_length).labels
        for batch, probs in batch_probs(model, labels, args.batch_size):
            for pred, gt in zip(model.tokenizer.decode(probs)[0], batch):
                correct += model.charset_adapter(pred) == gt
                total += 1
        print(f'{split}: running accuracy {100 * correct / max(total, 1):.2f}%')
    print(f'LM word accuracy: {100 * correct / max(total, 1):.2f}% ({correct}/{total})')
    return correct, total


if __name__ == '__main__':
    main()
