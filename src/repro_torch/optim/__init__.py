"""The optimizer and the gradient compressors (counterpart of
``repro/optim``): plain tensor code over ``{name: tensor}`` trees."""
