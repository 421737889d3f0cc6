"""Tensor ops of the port: framing, spectra, Gaussians, trellis, kernels."""
