from .manager import (AsyncCheckpointManager, CheckpointIntegrityError,
                      CheckpointManager, reshard_lanes)
