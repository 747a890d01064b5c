"""L6 distribution layer, counterpart of ``nerfds_tpu/parallel``."""
from nerfds_torch.parallel.mesh import (DATA_AXIS, DataMesh,  # noqa: F401
                                        all_gather_rows, all_reduce_max,
                                        all_reduce_mean, broadcast,
                                        check_batch_norm,
                                        create_mesh, pad_to_multiple,
                                        shard_batch)
