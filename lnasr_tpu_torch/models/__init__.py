"""Models of the port: MFCC frontend, HMM and GMM-HMM (inference)."""
