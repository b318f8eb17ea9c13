"""Feature-flag configuration — the analogue of the reference's debug.h.

The reference gates its paths with compile-time flags
(``DEBUG/CUFFT/EXTERNAL/MULTIPLE/TESTING``, SMFFT_CooleyTukey_C2C/debug.h:1-5,
SMFFT_Stockham_C2C/debug.h:1-7).  Here the knobs that still select
something are process-level settings read from the environment once at
import (so behavior is deterministic per run).

Flags:
  SMFFT_TESTING    — run golden verification in verify.py   (debug.h TESTING)
  SMFFT_PRECISION  — default precision tier (api.PRECISIONS)
"""

from __future__ import annotations

import dataclasses
import os


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "no", "off", "")


@dataclasses.dataclass
class Flags:
    testing: bool = _env_bool("SMFFT_TESTING", True)
    precision: str = os.environ.get("SMFFT_PRECISION", "highest")


flags = Flags()
