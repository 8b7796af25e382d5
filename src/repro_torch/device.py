"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, else raise.

    The port never falls back to the CPU on its own — a CPU run is asked
    for explicitly with ``device="cpu"`` (the tests do so)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_family(cfg) -> None:
    """The port covers the dense GQA/MHA family (optional qkv bias and
    qk-norm). Every other family stays in ROADMAP queue 1 item 7."""
    if (cfg.family != "dense" or cfg.attention_kind != "full"
            or cfg.is_moe or cfg.is_enc_dec or cfg.recurrent is not None
            or cfg.ssm is not None or cfg.frontend.kind != "none"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (attention "
            f"{cfg.attention_kind!r}) is not ported yet — see ROADMAP "
            "queue 1 item 7 (remaining model families)")
