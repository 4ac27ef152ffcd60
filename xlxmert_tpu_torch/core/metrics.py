"""Metrics & run logging (port of xlxmert_tpu/core/metrics.py).

Reference behavior (SURVEY.md §5): rank-0-only TensorBoard scalars +
log.txt FileHandler + tqdm LossMeters, each run dir snapshotting its
config (lxmert_pretrain.py:247-258,702-718; utils.py:52-72).

Here: RunLogger writing log.txt + scalars.jsonl (machine readable) and
TensorBoard only where `torch.utils.tensorboard` imports; LossMeter is
the same deque running mean.
"""
from __future__ import annotations

import json
import logging
import time
from collections import deque
from pathlib import Path
from typing import Dict


class LossMeter:
    """Running mean over the last `maxlen` values (utils.py:52-72)."""

    def __init__(self, maxlen: int = 100):
        self.vals = deque(maxlen=maxlen)

    def update(self, v: float):
        self.vals.append(float(v))

    @property
    def val(self) -> float:
        return sum(self.vals) / len(self.vals) if self.vals else 0.0

    def __len__(self):
        return len(self.vals)

    def __repr__(self):
        return f"{self.val:.4f}"


class RunLogger:
    def __init__(self, output_dir, config=None, enabled: bool = True,
                 use_tensorboard: bool = True):
        self.enabled = enabled
        self.dir = Path(output_dir)
        self.tb = None
        if not enabled:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        self.logger = logging.getLogger(f"xlxmert.{self.dir.name}")
        self.logger.setLevel(logging.INFO)
        for h in self.logger.handlers:  # reuse of the run-dir name
            h.close()
        self.logger.handlers = [logging.FileHandler(self.dir / "log.txt"),
                                logging.StreamHandler()]
        # don't ALSO emit through root handlers (absl/pytest configure
        # them) — every line would print twice
        self.logger.propagate = False
        self._scalars = open(self.dir / "scalars.jsonl", "a")
        if config is not None and hasattr(config, "save"):
            config.save(str(self.dir / "args.yaml"))
        self._snapshot_source()
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.dir / "tb"))
            except Exception:
                self.tb = None

    def _snapshot_source(self):
        """Snapshot the package source into the run dir for reproducibility
        (reference lxmert_pretrain.py:710-718, main.py:133-141)."""
        try:
            import shutil

            pkg = Path(__file__).resolve().parent.parent
            dst = self.dir / "src"
            if not dst.exists():
                shutil.copytree(pkg, dst,
                                ignore=shutil.ignore_patterns(
                                    "__pycache__", "*.so", "*.pyc",
                                    "_build"))
        except Exception:
            pass  # snapshotting must never block a run

    def info(self, msg: str):
        if self.enabled:
            self.logger.info(msg)

    def scalars(self, step: int, values: Dict[str, float], prefix: str = ""):
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({(f"{prefix}{k}" if prefix else k): float(v)
                    for k, v in values.items()})
        self._scalars.write(json.dumps(rec) + "\n")
        self._scalars.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(f"{prefix}{k}" if prefix else k, v, step)

    def close(self):
        if self.enabled:
            self._scalars.close()
            if self.tb is not None:
                self.tb.close()
