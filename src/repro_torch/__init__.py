"""PyTorch/CUDA port of the federated partial-layer-freezing system.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``repro_torch.core.client`` <-> ``repro.core.client``)
and never imports it or JAX.  Entry points run on the GPU by default
and raise without one unless the caller passes ``device="cpu"``.  The
server-side masked aggregation and the uplink codecs' quantize-pack run
through hand-written CUDA kernels (``kernels/masked_agg/csrc/
masked_agg.cu``, ``kernels/codec/csrc/quantize_pack.cu``), built with
``nvcc`` at first use.
"""
