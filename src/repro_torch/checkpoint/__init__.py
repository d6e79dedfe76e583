from .checkpointing import (AsyncCheckpointer, latest_step,  # noqa: F401
                            restore, save)
