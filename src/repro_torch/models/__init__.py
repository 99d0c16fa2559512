"""Model forward for the olmo family (GQA + SwiGLU) and bert-base's
encoder (bidirectional GQA + GeLU)."""
