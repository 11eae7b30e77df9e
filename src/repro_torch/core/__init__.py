"""Hardware-model primitives: fixed-point formats and their
straight-through quantizers, ±1 binarization and its estimators, the IMC
macro's count-exact MAV + sense-amplifier epilogue, and the means as the
reference computes them."""
