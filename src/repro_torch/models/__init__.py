"""Model forward for the olmo family (GQA + SwiGLU)."""
