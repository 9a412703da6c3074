from .seg_losses import (bce, bce_dice, binary_dice, boundary_combo_loss, boundary_gdice_loss,
                         boundary_loss, boundary_sdf, generalized_boundary_combo_loss,
                         generalized_dice, weighted_bce)
from .sr_losses import get_pseudo_lr, kbpn_loss, l1_per_sample, l2_per_sample
from .oriented import (crack_oriented_exp_weight, crack_oriented_weight, oriented_gaussian_map,
                       segment_failure_oriented_exp_weight, segment_failure_oriented_weight)
