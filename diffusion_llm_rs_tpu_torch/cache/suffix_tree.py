"""Suffix automaton for prompt / prefix-cache substring matching.

Counterpart of `diffusion_llm_rs_tpu/cache/suffix_tree.py` (pure Python,
copied): O(n) construction over one text, O(m) substring queries, and the
length of the longest prefix of a pattern found in the indexed text, the
prompt-cache reuse primitive `Engine.prefill` calls.
"""

from __future__ import annotations

from typing import Dict, List


class _State:
    __slots__ = ("len", "link", "next")

    def __init__(self, length: int = 0, link: int = -1):
        self.len = length
        self.link = link
        self.next: Dict[str, int] = {}


class SuffixTree:
    """Substring index over one text (suffix-automaton-backed)."""

    def __init__(self, text: str):
        self.text = text
        self._states: List[_State] = [_State()]
        self._last = 0
        for ch in text:
            self._extend(ch)

    def _extend(self, ch: str) -> None:
        states = self._states
        cur = len(states)
        states.append(_State(states[self._last].len + 1))
        p = self._last
        while p != -1 and ch not in states[p].next:
            states[p].next[ch] = cur
            p = states[p].link
        if p == -1:
            states[cur].link = 0
        else:
            q = states[p].next[ch]
            if states[p].len + 1 == states[q].len:
                states[cur].link = q
            else:
                clone = len(states)
                cl = _State(states[p].len + 1, states[q].link)
                cl.next = dict(states[q].next)
                states.append(cl)
                while p != -1 and states[p].next.get(ch) == q:
                    states[p].next[ch] = clone
                    p = states[p].link
                states[q].link = clone
                states[cur].link = clone
        self._last = cur

    def search(self, pattern: str) -> bool:
        """Substring membership (`suffix_tree.rs:65-78`)."""
        s = 0
        for ch in pattern:
            nxt = self._states[s].next.get(ch)
            if nxt is None:
                return False
            s = nxt
        return True

    def longest_match(self, pattern: str) -> int:
        """Length of the longest prefix of `pattern` that is a substring of
        the indexed text — the prompt-cache reuse primitive."""
        s, matched = 0, 0
        for ch in pattern:
            nxt = self._states[s].next.get(ch)
            if nxt is None:
                break
            s = nxt
            matched += 1
        return matched
