from .trainer import (TrainConfig, fit_flow_raw, fit_flows_batched,
                      train_flow, train_flows_batched)
