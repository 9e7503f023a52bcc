"""Training: AdamW with a cosine schedule, the microbatched train step and
the trainer loop with checkpoint / resume and the step watchdog."""
