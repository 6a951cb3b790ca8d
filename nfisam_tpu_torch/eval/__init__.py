from .metrics import (anchor_samples, array_order_to_dict, geodesic_distance,
                      kabsch_umeyama, mmd, rigid_gauge_transform, rmse,
                      sample_dict_to_array, sample_mean, translation_distance)
