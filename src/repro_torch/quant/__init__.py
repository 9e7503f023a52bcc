"""Int8 weight quantization for serving (the JAX package's ``quant``)."""
