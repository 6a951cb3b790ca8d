from .metrics import (anchor_samples, array_order_to_dict,
                      gaussian_displacement_graph_evidence,
                      gaussian_displacement_graph_moments,
                      gaussian_kernel_stein_discrepancy, geodesic_distance,
                      kabsch_umeyama, mmd, mmd_biased, mmd_sq_signed,
                      mmd_unbiased_sq, rigid_gauge_transform, rmse,
                      sample_dict_to_array, sample_mean, translation_distance)
from .viz import (confidence_ellipse, plot_2d_mean_trajectory,
                  plot_2d_samples, plot_likelihood_factor, plot_point,
                  plot_pose)
