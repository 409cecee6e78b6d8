from .config import YoloConfig, yolov8n
from .model import YoloV8, decode_predictions, init_yolo_params

__all__ = [
    "YoloConfig", "YoloV8", "decode_predictions", "init_yolo_params", "yolov8n",
]
