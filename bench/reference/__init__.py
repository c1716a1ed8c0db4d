"""The plain reference the benchmark judges ``repro_torch`` against.

Plain PyTorch, written from the published description of ColBERT,
Ward pooling and PLAID's residual codec as the configuration files in
``bench/configs`` state them. It imports nothing of the program (nor the
JAX package), takes only the benchmark's weights and tokens, and works
out every state the program's set-up builds again: the encodings, the
pooled vectors, the centroids, the codec and the codes.

``precision="f32"`` is the reference (TF32 off); ``precision="fp8"``
is the control: each product's two operands rounded to float8 e4m3 with
a per-tensor scale, the step below the bf16 the configurations state.
"""
