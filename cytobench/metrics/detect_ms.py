"""Mean milliseconds a batch of the detect (letterbox, YOLOv8n, DFL, NMS)
stage, from the engine's synchronised timings of
``process_batch_arrays(frames, timings)`` (``timings["yolo_detection"]``) over
the synced batches after the window."""


def read(rec):
    t = rec.get("stages", {}).get("yolo_detection")
    return sum(t) / len(t) * 1e3 if t else None
