"""Hardware-model primitives: fixed-point formats, ±1 binarization and the
IMC macro's count-exact MAV + sense-amplifier epilogue."""
