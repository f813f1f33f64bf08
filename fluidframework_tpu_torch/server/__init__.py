"""Ordering service: sequencer host, lambda pipeline, storm tick.

Reference parity: server/routerlicious/packages/* (deli, scriptorium,
broadcaster, scribe, lambdas-driver, memory-orderer).
"""
