"""Serving: the batched engine and POAS request dispatch."""
