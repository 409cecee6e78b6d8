"""YOLOv8 and SAM as ``nn.Module``s."""
