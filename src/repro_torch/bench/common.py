"""Shared helpers of the port's benchmarks: CSV emission per the harness
contract (``name,us_per_call,derived``), a wall-clock timer, result
persistence into the git-ignored ``results/`` directory beside this file,
and the name and power limit of the card a run measured."""
from __future__ import annotations

import json
import pathlib
import subprocess
import time
from typing import Optional, Tuple

import torch

RESULTS_DIR = pathlib.Path(__file__).resolve().parent / "results"


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.3f},{derived}")


def save_json(name: str, obj) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    (RESULTS_DIR / f"{name}.json").write_text(json.dumps(obj, indent=1))


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.s = time.perf_counter() - self.t0

    @property
    def us(self):
        return self.s * 1e6


def device_info(device: torch.device) -> Tuple[str, Optional[str]]:
    """(the device's name, the card's power limit as ``nvidia-smi``
    reports it, or None off the card)."""
    if device.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"], capture_output=True, text=True,
        check=True)
    return name, smi.stdout.strip()


def sync(device: torch.device) -> None:
    """Wait for the device's queued work, so a timed window holds it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
