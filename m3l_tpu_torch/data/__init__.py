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
from .sensors import (  # noqa: F401
    DIGIT_BGS_OBJECTS,
    DigitSlipDataset,
    DigitYCBSlideDataset,
    ForceFieldSSLDataset,
    GelsightGraspDataset,
    VisionForceSlipDataset,
    compute_diff,
    enhance_image,
    get_bg_img,
    load_bin_image,
    load_dataset_forces,
    load_dataset_poses,
    load_feeling_success,
    load_sample_from_buf,
    load_textile_dataset,
    resize_image,
)
