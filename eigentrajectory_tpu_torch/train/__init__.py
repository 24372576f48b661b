from .trainer import ETTorchTrainer
