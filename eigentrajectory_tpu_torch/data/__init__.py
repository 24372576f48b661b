from .batching import SceneBatch, SceneBatcher, pad_scenes
from .dataset import TrajectoryData, augment_trajectory, load_trajectory_data
from .synthetic import make_synthetic_data
