"""vofod_tpu_torch.pipeline."""
