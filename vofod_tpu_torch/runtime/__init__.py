"""vofod_tpu_torch.runtime."""
