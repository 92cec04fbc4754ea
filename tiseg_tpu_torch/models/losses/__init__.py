from .losses import (one_hot, cross_entropy, binary_cross_entropy, mse_loss, batch_multiclass_dice_loss,
                     batch_multiclass_sigmoid_dice_loss, multiclass_dice_loss, generalized_dice_loss, dice_loss,
                     focal_loss, gradient_mse_loss, masked_mse_loss, active_contour_loss, levelset_loss,
                     variance_loss, topological_loss, surface_loss, one_hot2dist, tdice, mdice, tiou, miou)

__all__ = [k for k in dir() if not k.startswith('_')]
