"""Model artifact loading: local paths, MLflow runs, MLflow registry.

Copy of ``yolo_sam_inference_tpu/utils/model_loader.py`` (the port may not
import the JAX package), plus :func:`torch_load`, the checkpoint file reader
the converters share. MLflow and boto/minio are optional, so the
network-backed loaders import lazily and raise a clear error when
unavailable; local checkpoint loading always works.
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path
from typing import Optional

from .logger import setup_logger

logger = setup_logger(__name__)


def torch_load(path, weights_only: bool = True):
    """``torch.load`` onto the CPU, memory-mapped where the file is in
    ``torch.save``'s zip format: a large checkpoint is then paged in as the
    converter reads it, never held twice."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=weights_only,
                      mmap=zipfile.is_zipfile(path))


def _require_mlflow():
    try:
        import mlflow  # type: ignore
    except ImportError as e:  # pragma: no cover - environment without mlflow
        raise RuntimeError(
            "mlflow is not installed in this environment; pass a local "
            "checkpoint path instead of an MLflow run/registry reference"
        ) from e
    return mlflow


def load_model_from_mlflow(
    experiment_id: str,
    run_id: str,
    model_artifact_path: str = "weights/best.pt",
    tracking_uri: Optional[str] = None,
) -> str:
    """Download a YOLO checkpoint from an MLflow run; returns local path.

    Mirrors reference ``utils/model_loader.py:9-39`` (artifact path ``weights/best.pt``).
    """
    mlflow = _require_mlflow()
    uri = tracking_uri or os.environ.get("MLFLOW_TRACKING_URI")
    if uri:
        mlflow.set_tracking_uri(uri)
    logger.info("Downloading model from MLflow run %s (%s)", run_id, model_artifact_path)
    local = mlflow.artifacts.download_artifacts(
        run_id=run_id, artifact_path=model_artifact_path
    )
    return str(local)


def load_model_from_registry(
    model_name: str,
    model_version: Optional[str] = None,
    tracking_uri: Optional[str] = None,
    s3_endpoint_url: Optional[str] = None,
    aws_access_key_id: Optional[str] = None,
    aws_secret_access_key: Optional[str] = None,
) -> str:
    """Download a model from the MLflow Model Registry (MinIO/S3 backed).

    Mirrors reference ``utils/model_loader.py:41-118`` including the
    latest-version resolution and the AWS/MLFLOW_S3 environment handshake.
    """
    mlflow = _require_mlflow()
    if s3_endpoint_url:
        os.environ["MLFLOW_S3_ENDPOINT_URL"] = s3_endpoint_url
    if aws_access_key_id:
        os.environ["AWS_ACCESS_KEY_ID"] = aws_access_key_id
    if aws_secret_access_key:
        os.environ["AWS_SECRET_ACCESS_KEY"] = aws_secret_access_key
    uri = tracking_uri or os.environ.get("MLFLOW_TRACKING_URI")
    if uri:
        mlflow.set_tracking_uri(uri)

    client = mlflow.tracking.MlflowClient()
    if model_version is None:
        versions = client.search_model_versions(f"name='{model_name}'")
        if not versions:
            raise ValueError(f"No versions found for registered model {model_name}")
        model_version = str(max(int(v.version) for v in versions))
        logger.info("Resolved latest version %s for model %s", model_version, model_name)
    local = mlflow.artifacts.download_artifacts(
        artifact_uri=f"models:/{model_name}/{model_version}"
    )
    return str(local)


def resolve_checkpoint(path_or_ref: str) -> str:
    """Resolve a checkpoint reference: local file path, or ``mlflow:<run>/<artifact>``."""
    if path_or_ref.startswith("mlflow:"):
        body = path_or_ref[len("mlflow:"):]
        run_id, _, artifact = body.partition("/")
        return load_model_from_mlflow("", run_id, artifact or "weights/best.pt")
    p = Path(path_or_ref)
    if not p.exists():
        raise FileNotFoundError(f"checkpoint not found: {p}")
    return str(p)
