"""Text chunking for long inputs.

The reference splits lines longer than ~300 chars at " , " boundaries with a
fragile ``round(len/max_len) != 1`` predicate (reference:
src/api/utils.py:64-80 — a 449-char line never splits).  Here any line over
the budget is split greedily at clause punctuation, then whitespace, so no
chunk exceeds the budget.
"""

from __future__ import annotations

import re
from typing import List, Sequence

_CLAUSE_SPLIT = re.compile(r"\s*[,;:]\s+")


def arrange_text(lines: Sequence[str], max_len: int = 300) -> List[str]:
    """Split/merge input lines into chunks of at most ``max_len`` chars."""
    chunks: List[str] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if len(line) <= max_len:
            chunks.append(line)
            continue
        parts = _CLAUSE_SPLIT.split(line)
        # re-split any clause still over budget at word boundaries
        pieces: List[str] = []
        for part in parts:
            while len(part) > max_len:
                cut = part.rfind(" ", 0, max_len)
                if cut <= 0:
                    cut = max_len
                pieces.append(part[:cut])
                part = part[cut:].strip()
            if part:
                pieces.append(part)
        # greedy merge back up to the budget (keeps chunks large => better
        # batch utilization, mirroring the reference's merge loop)
        cur = ""
        for p in pieces:
            if not cur:
                cur = p
            elif len(cur) + len(p) + 3 <= max_len:
                cur = f"{cur} , {p}"
            else:
                chunks.append(cur)
                cur = p
        if cur:
            chunks.append(cur)
    return chunks
