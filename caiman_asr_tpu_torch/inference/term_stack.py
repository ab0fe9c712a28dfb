"""Terminal partial/final rendering stack for the live demo client (the
port of ``caiman_asr_tpu/inference/term_stack.py``).

Reference behavior (inference/live_demo_client/stack.py): transcripts are
pushed word-by-word with ANSI colors — finals in green persist, the
current partial in red is popped and re-pushed as it revises — with
word-level line wrapping and cross-line deletion so the terminal always
shows exactly the committed text plus the latest provisional tail.

Own implementation: an entry stack over a cursor-column model with a
pluggable writer (unit-testable against an ANSI interpreter,
tests/inference/test_term_stack.py).
"""

from __future__ import annotations

import sys
from enum import Enum
from typing import List, Optional


class Style(Enum):
    FINAL = "\033[92m"    # green
    PARTIAL = "\033[0;31m"  # red


_RESET = "\033[0m"


class TermStack:
    """Push/pop styled word groups on the terminal with wrapping."""

    def __init__(self, cols: int = 80, out=None):
        self._cols = cols
        self._out = out if out is not None else sys.stdout
        self._entries: List[List[str]] = []  # words as rendered (with spaces)
        self._line_cols: List[int] = [0]     # cursor column per open line
        self._write("\n")

    # ------------------------------------------------------------- raw io
    def _write(self, s: str):
        self._out.write(s)
        self._out.flush()

    @property
    def _col(self) -> int:
        return self._line_cols[-1]

    @_col.setter
    def _col(self, v: int):
        self._line_cols[-1] = v

    # ------------------------------------------------------------ words
    @staticmethod
    def _split_words(msg: str) -> List[str]:
        """Words carrying their leading space; the first fragment keeps no
        space when the message continues a multi-token word."""
        if not msg:
            return []
        words = [f" {w}" for w in msg.split(" ") if w]
        if words and not msg.startswith(" "):
            words[0] = words[0][1:]
        return words

    def _push_word(self, word: str, sty: Optional[Style]) -> str:
        if len(word) >= self._cols:
            word = word[: self._cols - 1]  # hard cap: never exceed a line
        # wrap check applies to EVERY fragment: a continuing fragment (no
        # leading space) near the right edge must also break, or the write
        # passes self._cols and the cursor model desyncs from the terminal's
        # auto-wrap (pop() would then erase the wrong cells)
        if self._col + len(word) > self._cols:
            self._line_cols.append(0)
            self._write("\n")
        if word.startswith(" ") and self._col == 0:
            word = word[1:]
        self._col += len(word)
        if sty is None:
            self._write(word)
        else:
            self._write(f"{sty.value}{word}{_RESET}")
        return word

    # ----------------------------------------------------------- public
    def push(self, msg: str, sty: Optional[Style] = None):
        self._entries.append(
            [self._push_word(w, sty) for w in self._split_words(msg)]
        )

    def pop(self):
        """Remove the most recent entry from the screen (wrap-aware)."""
        if not self._entries:
            return
        for word in reversed(self._entries.pop()):
            n = len(word)
            if n == 0:
                continue
            if self._col == 0:
                # this word ended the previous line: move up, to its end
                self._line_cols.pop()
                self._write("\033[F")
                if self._col:
                    self._write(f"\033[{self._col}C")
            self._col -= n
            self._write("\b" * n + " " * n + "\b" * n)
