"""Build a warm-start init for a bigger preset from an exported model
(counterpart of the JAX package's ``scripts/make_transfer_init.py``).

Applies the function-preserving surgery chain (``models/surgery.py``:
widen → deepen → board resize) and writes a bundle that ``cli train
--init-from <out>`` and ``cli eval/play --workdir <out>`` accept, in
either package. Runs on the host; draws come from a CPU generator seeded
with ``--seed``. Example, 19×19 Renju from the bundled 15×15 model:

    python -m alphafive_tpu_torch.scripts.make_transfer_init \\
        --src pretrained/15x15 --preset train_19x19 --out runs/transfer19
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="exported model dir")
    ap.add_argument("--preset", required=True, help="destination preset")
    ap.add_argument("--out", required=True, help="output export dir")
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--noise", type=float, default=1e-2,
                    help="symmetry-breaking noise on duplicated filters")
    args = ap.parse_args(argv)

    from alphafive_tpu_torch.config import get_preset
    from alphafive_tpu_torch.models import surgery
    from alphafive_tpu_torch.train import checkpoint as ckpt

    params, bs, src_cfg = ckpt.load_model(args.src)
    dst = get_preset(args.preset)
    print(f"src: {src_cfg.env.board_size}x{src_cfg.env.board_size} "
          f"{src_cfg.net}", file=sys.stderr)
    print(f"dst: {dst.env.board_size}x{dst.env.board_size} {dst.net} "
          f"rules={dst.env.rules}", file=sys.stderr)
    v = surgery.transfer({"params": params, "batch_stats": bs},
                         src_cfg.env, src_cfg.net, dst.env, dst.net,
                         torch.Generator().manual_seed(args.seed),
                         noise=args.noise)
    ckpt.export_model(args.out, v["params"], v["batch_stats"], dst,
                      extra={"surgery_src": os.path.abspath(args.src),
                             "surgery_seed": args.seed})
    print(f"exported -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
