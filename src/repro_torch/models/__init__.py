"""The KWS network: its float QAT path and its hardware path."""
