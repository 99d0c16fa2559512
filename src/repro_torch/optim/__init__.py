"""Optimizers and schedules of the port (``repro/optim``): AdamW with
float32, bf16 or int8 moments, LAMB, cosine-with-warmup, knowledge
distillation (``distill``).  Gradient compression (ROADMAP Queue 1 item
14) is not ported."""
