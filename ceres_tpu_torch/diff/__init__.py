"""Differentiable rendering: losses and the inverse-rendering fit."""

from ceres_tpu_torch.diff.inverse import (TrainState, fit_vertices,
                                          image_loss, make_train_step)

__all__ = ["TrainState", "image_loss", "make_train_step", "fit_vertices"]
