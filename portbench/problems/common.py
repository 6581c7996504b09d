"""Pieces the problem sessions share: the configuration's keys and the
port's engine settings built from them, per-call permutation seeds, and the
module order the port tests modules in."""

from __future__ import annotations

import numpy as np


def seed63(seed: int) -> int:
    return int(seed) % (1 << 63)


def call_seed(seed: int, index: int) -> int:
    """The permutation seed of call ``index`` of a run (index -1: the warm
    call): a 31-bit integer drawn from the run's seed."""
    tag = 0xCA11 if index >= 0 else 0x3A43
    words = np.random.SeedSequence([seed63(seed), tag, max(index, 0)])
    return int(words.generate_state(1)[0]) & 0x7FFFFFFF


def label_order(labels) -> list[str]:
    """Module labels as the port orders them: by length, then text."""
    return sorted({str(v) for v in labels if str(v) != "0"},
                  key=lambda s: (len(s), s))


def modules_of(labels) -> list[np.ndarray]:
    """Each module's node positions (in node order), modules in the port's
    order."""
    labels = np.asarray([str(v) for v in labels], dtype=object)
    return [np.flatnonzero(labels == lab) for lab in label_order(labels)]


#: keys every configuration file has: what it is, what the port stores and
#: how (``storage`` is the engine's ``dtype``, ``engine`` the rest of
#: ``EngineConfig``'s keywords), and words for the reader
COMMON_KEYS = ("kind", "deployment", "inputs", "assumed", "structure_seed",
               "storage", "tf32", "engine")
#: bytes of one stored element, by ``storage``
WIDTH = {"float32": 4, "bfloat16": 2}


def check_keys(cfg: dict, keys) -> None:
    """Refuse a configuration with a key its kind does not apply, or
    without one it needs."""
    allowed = set(COMMON_KEYS) | set(keys)
    extra = sorted(set(cfg) - allowed)
    missing = sorted(allowed - set(cfg))
    if extra or missing:
        raise ValueError(f"{cfg.get('kind')!r} configuration: keys not applied "
                         f"{extra}, keys missing {missing}")


def engine_config(cfg: dict):
    """The port's ``EngineConfig`` as the configuration states it."""
    from netrep_tpu_torch.utils.config import EngineConfig

    return EngineConfig(dtype=cfg["storage"], **cfg["engine"])
