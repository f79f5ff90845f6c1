"""Assigned-architecture configs.  ``--arch <id>`` resolves through here."""

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        command_r_35b,
        internvl2_1b,
        minitron_8b,
        mixtral_8x22b,
        musicgen_medium,
        qwen1_5_32b,
        qwen2_5_32b,
        qwen2_moe_a2_7b,
        recurrentgemma_2b,
        rwkv6_1_6b,
    )
    _LOADED = True


from .base import ArchConfig, get, names, REGISTRY  # noqa: E402

__all__ = ["ArchConfig", "get", "names", "REGISTRY"]
