"""Device detector -- Algorithm 2 of the paper.

Detects available accelerator (NPU/GPU) and CPU devices, decides the
main/auxiliary roles and worker counts, and force-disables heterogeneous
computing when only one device type exists.

In this port "NPU" means a CUDA device; the CPU pool is the host.
``detect()`` can also be fed an explicit inventory so tests and the
simulator can exercise every branch of Algorithm 2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class DeviceInventory:
    npus: int            # accelerator instance slots (I in the paper)
    cpus: int            # CPU instance slots (J in the paper)


@dataclass(frozen=True)
class DetectionResult:
    device_main: str                 # 'npu' | 'cpu' | 'none'
    device_auxiliary: str            # 'cpu' | 'none'
    worker_num_main: int
    worker_num_auxiliary: int
    heter_enable: bool


def detect(inventory: Optional[DeviceInventory] = None,
           heter_requested: bool = True) -> DetectionResult:
    """Algorithm 2, verbatim branch structure."""
    if inventory is None:
        inventory = probe_torch_devices()
    I, J = inventory.npus, inventory.cpus

    if I > 0:  # npu is available
        if heter_requested and J > 0:
            return DetectionResult("npu", "cpu", I, J, True)
        return DetectionResult("npu", "none", I, 0, False)
    # no NPU: CPU-only service; heterogeneous computing force-disabled
    if J > 0:
        return DetectionResult("cpu", "none", J, 0, False)
    return DetectionResult("none", "none", 0, 0, False)


def probe_torch_devices() -> DeviceInventory:
    import torch

    # paper recommendation (§4.3): one CPU instance per machine
    return DeviceInventory(npus=torch.cuda.device_count(), cpus=1)
