"""I/O: dataset readers, trajectory formats, config, visualization."""

from nislam_tpu.io.dataset import (  # noqa: F401
    ImageFolderDataset,
    NisfDataset,
    SyntheticDataset,
    TumRgbdDataset,
    open_dataset,
)
from nislam_tpu.io.trajectory import (  # noqa: F401
    ate_rmse,
    pose2d_to_tum_line,
    read_tum,
    write_tum,
)
