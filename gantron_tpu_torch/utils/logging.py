"""Metric logging (copy of gantron_tpu/utils/logging.py; reference:
logger.py, wandb calls in train.py).

The reference logs everything to Weights & Biases. Here a thin interface
with the same metric names/semantics writes JSONL (always) + console, and
forwards to wandb when it is installed (it is optional).

Metric keys are prettified the same way as reference logger.py:10-14
("mel_loss" -> "Mel loss").
"""

import json
import os
import time
from typing import Optional


def _pretty(key: str) -> str:
    return key.replace("_", " ").capitalize()


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricLogger:
    def __init__(self, output_directory: Optional[str] = None,
                 run_name: str = "run", use_wandb: bool = False,
                 wandb_project: str = "Compare", config: Optional[dict] = None,
                 quiet: bool = False):
        self.quiet = quiet
        self._file = None
        if output_directory:
            os.makedirs(output_directory, exist_ok=True)
            self._file = open(
                os.path.join(output_directory, f"{run_name}.metrics.jsonl"),
                "a", buffering=1)
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                wandb.init(project=wandb_project, name=run_name,
                           config=config or {})
                self._wandb = wandb
            except ImportError:
                pass

    def info(self, msg: str):
        if not self.quiet:
            print(msg)

    def progress(self, iteration: int, total: Optional[int], **metrics):
        """tqdm-style live progress (reference train.py:284-293, 348-351):
        a carriage-return-updated status line on a tty, a periodic plain
        line otherwise."""
        if self.quiet:
            return
        import sys

        text = " ".join(f"{k}={_scalar(v):.4g}" for k, v in metrics.items())
        total_s = f"/{total}" if total else ""
        line = f"iter {iteration}{total_s} {text}"
        if sys.stdout.isatty():
            print("\r" + line.ljust(78)[:78], end="", flush=True)
        elif iteration % 50 == 0:
            print(line, flush=True)

    def log_media(self, step: int, images: Optional[dict] = None,
                  audios: Optional[dict] = None, sample_rate: int = 22050):
        """Validation media (reference logger.py:17-61): image paths/arrays
        and audio waveforms, uploaded to wandb when active."""
        if self._wandb is None:
            return
        record = {}
        for name, img in (images or {}).items():
            record[name] = self._wandb.Image(img)
        for name, wav in (audios or {}).items():
            record[name] = self._wandb.Audio(wav, sample_rate=sample_rate)
        if record:
            self._wandb.log(record, step=step)

    def log_values(self, step: int, commit: bool = False, **kwargs):
        record = {_pretty(k): _scalar(v) for k, v in kwargs.items()}
        if self._file is not None:
            self._file.write(json.dumps(
                {"step": step, "time": time.time(), **record}) + "\n")
        if self._wandb is not None:
            self._wandb.log(record, step=step, commit=commit)

    def log_validation(self, mel_loss, gate_loss, attn_loss, step,
                       media: Optional[dict] = None):
        self.log_values(step, validation_mel_loss=mel_loss,
                        validation_gate_loss=gate_loss,
                        validation_attention_loss=attn_loss)
        if not self.quiet:
            print(f"{step} Validation mel loss {mel_loss} "
                  f"gate loss {gate_loss}")
        if media and self._wandb is not None:
            self._wandb.log(media, step=step)

    def save_file(self, path: str):
        """Checkpoint upload hook (reference train.py:455-465 wandb.save).
        No-op without wandb."""
        if self._wandb is not None:
            try:
                self._wandb.save(path)
            except (OSError, ValueError):
                pass

    def close(self):
        if self._file is not None:
            self._file.close()
