"""Training and customization drivers of the KWS model (``kws.py``): the
float QAT loop (``train_base``, the noise-aware recovery fine-tune) and
``evaluate``, the hardware feature extractor and the test-mode bias
compensation."""
