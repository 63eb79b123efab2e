"""The benchmark's plain reference: what an AVIF file that the encoder
returned must be, worked out from the input image and the configuration
alone. It imports nothing of the program."""
