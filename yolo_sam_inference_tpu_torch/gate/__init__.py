"""ROI gating: per-condition cell filtering and ``roi_coordinates.json``."""

from .filter import filter_cells_by_roi, load_roi_coordinates, save_roi_coordinates

__all__ = ["filter_cells_by_roi", "load_roi_coordinates", "save_roi_coordinates"]
