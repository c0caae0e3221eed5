"""What the model decks share: parameters as tensors on the deck's device
and the map-based powertrain every deck builds."""

from __future__ import annotations

import torch

from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.vehicle.powertrain import (
    PowertrainParams, default_engine_map,
)
from chrono_tpu_torch.vehicle.wheeled import DRIVEN


def tensors(dtype, device, **values):
    """Each value as a tensor of ``dtype`` on ``device`` (the card unless
    it names another)."""
    device = resolve_device(device, "a model deck")
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in values.items()}


def powertrain_deck(max_torque, max_power_speed, max_speed, gears, shifts,
                    final, driven, efficiency, loss_scale=1.0,
                    dtype=torch.float32, device=None) -> PowertrainParams:
    """``default_engine_map`` with these three speeds and torque, the gear
    ratios, upshift speeds, final drive and driven wheels of a deck."""
    device = resolve_device(device, "a model deck")
    speeds, torques, losses = default_engine_map(
        max_torque=max_torque, max_power_speed=max_power_speed,
        max_speed=max_speed, dtype=dtype, device=device)
    if loss_scale != 1.0:
        losses = losses * loss_scale
    return PowertrainParams(
        map_speed=speeds, map_torque=torques, map_losses=losses,
        **tensors(dtype, device, max_speed=max_speed,
                  gear_ratios=list(gears), shift_speeds=list(shifts),
                  final_drive=final, driven_wheels=DRIVEN[driven],
                  efficiency=efficiency))
