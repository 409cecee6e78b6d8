"""The benchmark of the PyTorch and CUDA port (``yolo_sam_inference_tpu_torch``).

    python3 -m cytobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once on one card and prints one JSON
line. Everything it measures with and judges by lives here: the traffic
generator, the weight maker, the operation counts, the plain fp32 reference
and the comparison. From the port it takes only the pipeline under test.
Nothing here imports JAX or the JAX package.
"""
