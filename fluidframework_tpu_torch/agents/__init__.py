"""Background agents — headless clients doing work on documents.

Reference parity: server/headless-agent (a headless client that loads
documents and runs agents against them) + packages/agents/
intelligence-runner-agent (text analytics writing into the document's
insights map) + spellchecker-agent. Work arrives through the foreman
lambda's help assignments (REMOTE_HELP ops → durable assignment records);
agents claim assignments, edit the document through a perfectly ordinary
client stack, and mark them complete.
"""

from .headless import HeadlessAgentRunner, INSIGHTS_CHANNEL
from .intelligence import SpellCheckerAgent, TextAnalyticsAgent

__all__ = [
    "HeadlessAgentRunner", "INSIGHTS_CHANNEL",
    "SpellCheckerAgent", "TextAnalyticsAgent",
]
