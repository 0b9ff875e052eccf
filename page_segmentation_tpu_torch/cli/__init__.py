"""command line of the PyTorch/CUDA port (mirrors page_segmentation_tpu.cli)."""
