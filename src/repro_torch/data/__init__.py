from .pipeline import (DataConfig, TokenPipeline,  # noqa: F401
                       global_batch_to_device)
