"""CLI for the port's micro-batching inference service (``web/serve.py``).

The JAX package's ``apps/serve.py`` with the same arguments, plus
``--device`` (the card unless asked for the CPU). Example:

  python -m yolo_sam_inference_tpu_torch.apps.serve \\
      --sam-model facebook/sam-vit-base --batch-size 32 \\
      --image-size 512x512 --port 9488

Then:  curl -X POST --data-binary @frame.png localhost:9488/segment
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Micro-batching inference service")
    p.add_argument("--sam-model", default="facebook/sam-vit-base")
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--yolo-model", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-det", type=int, default=24)
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="partial-batch dispatch deadline")
    p.add_argument("--image-size", default=None,
                   help="HxW (grayscale) or HxWx3 (true color); fixes the "
                        "geometry and warms it at startup "
                        "(otherwise the first request's shape wins)")
    p.add_argument("--quant", choices=("none", "int8"), default="none")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; pass 0.0.0.0 explicitly to expose "
                        "the service beyond this host")
    p.add_argument("--port", type=int, default=9488)
    args = p.parse_args(argv)

    from ..pipeline.engine import CellSegmentationPipeline, PipelineOptions
    from ..web.serve import serve

    shape = None
    if args.image_size:
        shape = tuple(int(v) for v in args.image_size.lower().split("x"))
        if len(shape) not in (2, 3) or (len(shape) == 3 and shape[2] != 3):
            p.error("--image-size must be HxW or HxWx3")
    pipe = CellSegmentationPipeline(
        yolo_model_path=args.yolo_model,
        sam_model_type=args.sam_model,
        sam_checkpoint=args.sam_checkpoint,
        device=args.device,
        options=PipelineOptions(batch_size=args.batch_size,
                                max_det=args.max_det, quant=args.quant),
    )
    server, service = serve(pipe, host=args.host, port=args.port,
                            batch_size=args.batch_size,
                            max_wait_ms=args.max_wait_ms, image_shape=shape)
    print(f"serving on {args.host}:{server.server_address[1]} "
          f"(batch={args.batch_size}, wait={args.max_wait_ms}ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
