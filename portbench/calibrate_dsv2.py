"""``calibrate.py`` for the DeepSeek-V2 cell, with two more planted faults:
``expert_offset``, the program's held experts shifted by one (its weights
of experts 0-7 used as experts 1-8), which the routing cannot see and the
gradients must; ``expert_dx_zero``, the held experts' input gradient
zeroed in the grouped products' backward (their forward left whole).

    python3 portbench/calibrate_dsv2.py --workload train-longform.dsv2lite --seeds 11 12 \
        --seconds 1 [--control] [--fault half_batch|expert_offset|expert_dx_zero] [--dump <file>]
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import calibrate  # noqa: E402

_planted = calibrate.planted


@contextlib.contextmanager
def planted(fault):
    if fault == "expert_offset":
        from portbench.drivers import train_dsv2

        real = train_dsv2.lm_config
        train_dsv2.lm_config = lambda config: dataclasses.replace(real(config), expert_offset=1)
        try:
            yield
        finally:
            train_dsv2.lm_config = real
    elif fault == "expert_dx_zero":
        from aat_tpu_torch.models import deepseek_v2 as dsv2

        real = dsv2._GroupedMatmul.backward

        def backward(ctx, dy):
            dx, *rest = real(ctx, dy)
            return (None if dx is None else torch.zeros_like(dx), *rest)

        dsv2._GroupedMatmul.backward = staticmethod(backward)
        try:
            yield
        finally:
            dsv2._GroupedMatmul.backward = staticmethod(real)
    else:
        with _planted(fault):
            yield


calibrate.planted = planted


def readings(run, fault=None, dump=None) -> dict:
    return calibrate.readings(run, fault, dump)


if __name__ == "__main__":
    sys.exit(calibrate.main())
