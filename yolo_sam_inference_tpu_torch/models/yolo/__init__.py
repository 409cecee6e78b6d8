from .config import YoloConfig, yolov8m, yolov8n, yolov8s
from .convert import convert_ultralytics_state_dict, load_yolo_params
from .model import YoloV8, decode_predictions, init_yolo_params

__all__ = [
    "YoloConfig", "YoloV8", "convert_ultralytics_state_dict", "decode_predictions",
    "init_yolo_params", "load_yolo_params", "yolov8m", "yolov8n", "yolov8s",
]
