"""Customization drivers over the folded KWS model: the hardware feature
extractor and the test-mode bias compensation (``kws.py``)."""
