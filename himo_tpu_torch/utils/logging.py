"""Training/eval metrics logging (a copy of ``himo_tpu/utils/logging.py``:
the reference's wandb surface, ssl-train-av2.sh:31, without the external
service).

``MetricsLogger`` appends JSON lines to ``{run_dir}/metrics.jsonl``, prints
compact console summaries, and forwards to wandb when available AND
``wandb_mode != 'disabled'`` — fully offline by default. Under a process
group only rank 0 logs: on the other ranks every method does nothing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

from himo_tpu_torch.parallel.mesh import process_index


class MetricsLogger:
    def __init__(
        self,
        run_dir,
        project: str = "himo_tpu",
        wandb_mode: str = "disabled",
        config: Optional[dict] = None,
    ):
        self.writer = process_index() == 0
        self.run_dir = Path(run_dir)
        self._wandb = None
        if not self.writer:
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / "metrics.jsonl"
        self._file = open(self.path, "a")
        self._start = time.time()
        if wandb_mode != "disabled":
            try:
                import wandb

                self._wandb = wandb.init(
                    project=project, mode=wandb_mode, config=config or {}
                )
            except Exception as exc:  # wandb not installed / no auth
                print(f"[logging] wandb unavailable ({exc}); using jsonl only")
        if config is not None:
            (self.run_dir / "config.json").write_text(json.dumps(config, indent=2, default=str))

    def log(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        if not self.writer:
            return
        record = {
            "step": step,
            "time": round(time.time() - self._start, 3),
            **{f"{prefix}{k}": float(v) for k, v in metrics.items()},
        }
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def print(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        if not self.writer:
            return
        parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        print(f"[{prefix}step {step}] {parts}")

    def close(self) -> None:
        if not self.writer:
            return
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
