"""2D -> 3D instance segmentation: FlashSplat lifting, find-&-match and
its evaluation (counterpart of wheat3dgs_tpu/seg/)."""
