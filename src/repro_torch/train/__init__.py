"""Training: AdamW with a cosine schedule, the microbatched train step (on
one device or sharded over a mesh), the compressed data-parallel step and
its gradient collectives, and the trainer loop with checkpoint / resume
and the step watchdog."""
