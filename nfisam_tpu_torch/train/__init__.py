from .trainer import TrainConfig, fit_flow_raw, train_flow
