"""vofod_tpu_torch.ops."""
