from repro_torch.checkpoint.ckpt import (load_checkpoint,  # noqa: F401
                                         read_checkpoint, save_checkpoint)
