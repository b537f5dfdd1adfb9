"""Long-form text chunking for synthesis, copied from
everyvoice_tpu/text/textsplit.py (plain ``re``, no third-party modules).

Splits text into chunks around ``desired_length`` characters, preferring
strong sentence boundaries (``!?.``) and falling back to weak ones
(``:;,``), quote-aware. Chunks are synthesized independently and the audio
re-concatenated, which bounds the sequence length of each forward.
"""

from __future__ import annotations

import re


def chunk_text(
    text: str,
    desired_length: int = 100,
    max_length: int = 200,
    strong_boundaries: str = "!?.",
    weak_boundaries: str = ":;,",
) -> list:
    """Split ``text`` into chunks of roughly ``desired_length`` characters.

    >>> chunk_text('Short sentence.')
    ['Short sentence.']
    >>> chunk_text('One. Two. Three.', desired_length=5, max_length=20)
    ['One. Two.', 'Three.']
    """
    assert desired_length < max_length

    text = re.sub(r"\n\n+", "\n", text)
    text = re.sub(r"\s+", " ", text)
    n = len(text)

    chunks: list = []
    start = 0  # absolute index where the open chunk begins
    strong_cuts: list = []  # absolute offsets "may split before text[i:]"
    weak_cuts: list = []
    quoted = False

    for pos in range(n):
        char = text[pos]
        if char == '"':
            quoted = not quoted
        nxt = text[pos + 1] if pos + 1 < n else ""
        # A boundary only counts outside quotes, before a separator or at
        # end-of-text (the text is whitespace-normalized, so a space is the
        # only separator left).
        at_strong = (
            not quoted
            and char in strong_boundaries
            and nxt in ("", " ", "\n")
        )
        if at_strong:
            strong_cuts.append(pos + 1)
        elif (
            not quoted
            and char in weak_boundaries
            and nxt in ("", " ", "\n")
        ):
            weak_cuts.append(pos + 1)

        if pos + 1 - start >= max_length:
            # Overflow: fall back to the latest boundary seen in THIS chunk
            # (strong preferred), else hard-cut at the window edge. Either
            # way the recorded offsets are dropped — the carried-over tail
            # starts with a clean slate.
            fallback = (
                strong_cuts[-1] if strong_cuts
                else weak_cuts[-1] if weak_cuts
                else None
            )
            if fallback is None:
                chunks.append(text[start : pos + 1].strip())
                start = pos + 1
            else:
                chunks.append(text[start:fallback].strip())
                start = fallback
                while start < pos + 1 and text[start] == " ":
                    start += 1
            strong_cuts.clear()
            weak_cuts.clear()
        elif at_strong and pos + 1 - start >= desired_length:
            # Preferred: close the chunk at the first strong boundary once
            # it is long enough.
            piece = text[start : pos + 1].strip()
            if piece:
                chunks.append(piece)
            start = pos + 1
            strong_cuts.clear()
            weak_cuts.clear()

    tail = text[start:].strip()
    if tail:
        chunks.append(tail)

    non_lexical = rf"^[\s{re.escape(strong_boundaries + weak_boundaries)}]*$"
    return [c for c in chunks if c and not re.match(non_lexical, c)]
