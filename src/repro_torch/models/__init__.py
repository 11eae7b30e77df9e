"""The KWS network's hardware path."""
