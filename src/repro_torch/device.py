"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ATTN, RECURRENT

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, else raise.

    The port never falls back to the CPU on its own — a CPU run is asked
    for explicitly with ``device="cpu"`` (the tests do so). ``"meta"``
    (shapes and dtypes, nothing allocated or computed: the launch layer's
    abstract arguments and the roofline's counts) is taken only when
    asked for by name, never as a default."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_family(cfg) -> None:
    """The port covers the dense GQA/MHA family (optional qkv bias and
    qk-norm), sliding-window attention, multi-head latent attention (MLA,
    DeepSeek-V2), MoE MLPs over any of these (Mixtral, DeepSeek-V2-Lite),
    the hybrid of RG-LRU recurrent blocks and local attention (Griffin /
    RecurrentGemma), the attention-free Mamba-2 SSD family, the vision
    frontend (patch embeddings before the prompt) and the encoder-decoder
    family (the audio frontend: an encoder over frame embeddings, decoder
    layers that cross-attend to its memory), each over full attention
    and without MoE. Anything else raises ``NotImplementedError``."""
    hybrid = (cfg.family == "hybrid" and cfg.recurrent is not None
              and cfg.attention_kind in ("full", "sliding") and not cfg.is_moe
              and set(cfg.recurrent.block_pattern) <= {RECURRENT, ATTN})
    ssm = (cfg.family == "ssm" and cfg.ssm is not None
           and cfg.attention_kind == "none" and not cfg.is_moe)
    vlm = (cfg.family == "vlm" and cfg.frontend.kind == "vision"
           and cfg.attention_kind == "full" and not cfg.is_moe)
    encdec = (cfg.is_enc_dec and cfg.frontend.kind == "audio"
              and cfg.attention_kind == "full" and not cfg.is_moe
              and cfg.recurrent is None and cfg.ssm is None)
    attention_ok = ssm or cfg.attention_kind in ("full", "sliding") or (
        cfg.attention_kind == "mla" and cfg.mla is not None)
    family_ok = cfg.family == "dense" or hybrid or ssm or vlm or encdec or (
        cfg.family == "moe" and cfg.is_moe)
    if (not attention_ok or not family_ok
            or (cfg.is_moe and cfg.family != "moe")
            or (cfg.is_enc_dec and not encdec)
            or (cfg.recurrent is not None and not hybrid)
            or (cfg.ssm is not None and not ssm)
            or (cfg.frontend.kind != "none" and not (vlm or encdec))):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (attention "
            f"{cfg.attention_kind!r}) is not a family the port serves — "
            "see ROADMAP queue 1 item 7 (the model families)")
