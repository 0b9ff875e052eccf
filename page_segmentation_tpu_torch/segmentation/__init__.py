"""Region segmentation of the PyTorch/CUDA port (mirrors
page_segmentation_tpu.segmentation)."""
