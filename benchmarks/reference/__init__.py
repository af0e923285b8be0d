"""The benchmark's plain reference of one 3DGS training step.

Written from the published method (Kerbl et al. 2023, "3D Gaussian
Splatting for Real-Time Radiance Field Rendering", and its reference code:
gaussian_renderer, utils/loss_utils.py, scene/gaussian_model.py), in plain
PyTorch and float32. It imports nothing of the program under test and none
of JAX. Departures from the published code, all of them the settings the
port states: 32-pixel tiles (the tile sets which pixels a splat's radius
rectangle reaches), no centre crop of very large footprints, and no
screen-radius prune (it never fires in the published code either).
"""
