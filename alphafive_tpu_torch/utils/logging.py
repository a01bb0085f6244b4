"""Structured metrics: a JSONL stream, a console line and, where it
imports, TensorBoard (port of ``alphafive_tpu/utils/logging.py``).

Every record becomes one JSON object in ``<workdir>/metrics.jsonl``
(``"t"``, the seconds since the logger started, first) and one compact
line on stderr. TensorBoard scalars go under ``<workdir>/tb/`` through
``torch.utils.tensorboard`` when its ``tensorboard`` package is installed
(the JAX package uses ``tensorboardX``); without it the logger writes the
stream alone. With ``workdir=None`` no file is written.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

CONSOLE_KEYS = ("iter", "loss", "policy_loss", "value_loss", "kl_pi_p",
                "env_steps_per_s", "sims_per_s", "buffer_size",
                "games_finished", "score", "elo", "anchor_rollouts")


class MetricsLogger:
    def __init__(self, workdir: Optional[str], quiet: bool = False,
                 tensorboard: bool = True):
        self.quiet = quiet
        self.f = None
        self.tb = None
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self.f = open(os.path.join(workdir, "metrics.jsonl"), "a",
                          buffering=1)
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None   # the tensorboard package is optional
                if SummaryWriter is not None:
                    self.tb = SummaryWriter(os.path.join(workdir, "tb"))
        self.t0 = time.time()

    def log(self, record: Dict[str, Any]) -> None:
        record = {"t": round(time.time() - self.t0, 3), **record}
        if self.f:
            self.f.write(json.dumps(record, default=float) + "\n")
        if self.tb is not None and "iter" in record:
            kind = record.get("kind", "iter")
            step = int(record["iter"])
            for k, v in record.items():
                if isinstance(v, (int, float)) and k not in ("iter", "t"):
                    self.tb.add_scalar(f"{kind}/{k}", float(v), step)
        if not self.quiet:
            kind = record.get("kind", "iter")
            msg = " ".join(f"{k}={_fmt(record[k])}" for k in CONSOLE_KEYS
                           if k in record)
            print(f"[{kind}] {msg}", file=sys.stderr)

    def close(self) -> None:
        if self.f:
            self.f.close()
        if self.tb is not None:
            self.tb.close()


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return v
