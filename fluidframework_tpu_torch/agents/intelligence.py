"""Intelligence agents — deterministic document analytics.

Reference parity: packages/agents/intelligence-runner-agent (text
analytics run over SharedString content, results written to the insights
map) and spellchecker-agent. The analytics here are deterministic local
computations — the reference's cloud-service calls are out of scope, the
agent *plumbing* (load → analyze → write insights) is the component.
"""

from __future__ import annotations

import re
from collections import Counter

from ..dds.sequence import SharedString

_WORD_RE = re.compile(r"[A-Za-z']+")


def _document_texts(container) -> list[str]:
    """Every SharedString channel's text across all data stores."""
    texts = []
    for datastore in container.runtime.datastores.values():
        for channel_id in datastore.channel_ids():
            if datastore.channel_type(channel_id) \
                    != SharedString.channel_type:
                continue  # non-string channels stay unrealized
            channel = datastore.get_channel(channel_id)
            if isinstance(channel, SharedString):
                texts.append(channel.get_text())
    return texts


class TextAnalyticsAgent:
    """Word/char statistics + top terms (intelligence-runner's
    textAnalytics shape)."""

    name = "intelligence"

    def __init__(self, top_n: int = 5) -> None:
        self._top_n = top_n

    def run(self, container) -> dict:
        texts = _document_texts(container)
        words = [w.lower() for text in texts
                 for w in _WORD_RE.findall(text)]
        # Deterministic order: count desc, then alphabetical.
        top = sorted(Counter(words).items(), key=lambda kv: (-kv[1], kv[0]))
        return {
            "char_count": sum(len(t) for t in texts),
            "word_count": len(words),
            "string_count": len(texts),
            "top_words": [w for w, _ in top[:self._top_n]],
        }


class SpellCheckerAgent:
    """Flags words not in the dictionary (spellchecker-agent shape)."""

    name = "spell"

    DEFAULT_DICTIONARY = frozenset(
        "a an and are hello is of the this to world word words write"
        .split())

    def __init__(self, dictionary=None) -> None:
        self._dictionary = frozenset(
            dictionary if dictionary is not None else
            self.DEFAULT_DICTIONARY)

    def run(self, container) -> dict:
        words = {w.lower() for text in _document_texts(container)
                 for w in _WORD_RE.findall(text)}
        return {"misspelled": sorted(words - self._dictionary)}
