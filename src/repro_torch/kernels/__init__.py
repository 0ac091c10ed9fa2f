"""Hand-written Hopper kernels with their plain PyTorch versions.

  ibn_conv  — pointwise (1x1) conv + bias + activation (CUDA C++, sm_90a),
              replacing repro/kernels/ibn_conv.py::ibn_pointwise

ops.py is the dispatch the model code calls, ref.py the plain versions.
The TPU kernels flash_attention, ssd_scan and gmm are not ported yet.
"""
