from .datasets import (  # noqa: F401
    ArrayDataset,
    DataLoader,
    VisionTactileDataset,
    background_difference,
    load_pickle_dataset,
    random_crop_resize,
    random_flip,
)
from .task_datasets import LABEL_KEYS, bin_labels, make_task_dataset  # noqa: F401
from .synthetic import forcefield_windows, render_frame, synth_digit_trajectories, windowed_probe_samples  # noqa: F401
