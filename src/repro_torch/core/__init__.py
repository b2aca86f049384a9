"""Compression core: PRNG, quantization, operators, bucket layout, the DIANA round."""
