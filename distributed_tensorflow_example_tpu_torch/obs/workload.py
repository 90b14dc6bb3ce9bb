"""The submit span's prompt fingerprint — the port's copy of
``prompt_fingerprint`` from the JAX package's ``obs/workload.py``.

Workload capture and replay read the fingerprint; they are not ported
yet (ROADMAP.md Queue A), but the span stream carries it so a captured
stream keeps its shared-prefix structure without storing the prompts.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List

# prompt tokens per fingerprint block: the default KV page size, so one
# fingerprint entry stands for one shareable page
FINGERPRINT_BLOCK = 16

# hex digits per fingerprint entry (48 bits)
_FP_HEX = 12


def prompt_fingerprint(tokens: Iterable[int],
                       block: int = FINGERPRINT_BLOCK) -> List[str]:
    """Chained per-block prompt hash: entry ``i`` digests block ``i``'s
    tokens and entry ``i-1``, so two fingerprints share a prefix exactly
    when the prompts share a token prefix."""
    toks = [int(t) for t in tokens]
    if block < 1:
        raise ValueError(f"block={block} must be >= 1")
    out: List[str] = []
    prev = b""
    for i in range(0, len(toks), block):
        h = hashlib.sha1()
        h.update(prev)
        h.update(",".join(str(t) for t in toks[i:i + block]).encode())
        digest = h.hexdigest()[:_FP_HEX]
        out.append(digest)
        prev = digest.encode()
    return out


__all__ = ["FINGERPRINT_BLOCK", "prompt_fingerprint"]
