"""Classical (model-free) cell detection on the port.

Counterpart of the JAX package's ``classical/``: the pixel-heavy stages
(absdiff, blur, threshold, morphology) run batched on the card
(``ops/morphology.py``); connected components (``scipy.ndimage.label``) and
contour topology (cv2) stay on the host.
"""

from .pipeline import ClassicalParams, ClassicalPipeline

__all__ = ["ClassicalPipeline", "ClassicalParams"]
