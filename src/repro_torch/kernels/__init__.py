"""Hand-written Hopper kernels with their plain PyTorch versions.

  ibn_conv         — pointwise (1x1) conv + bias + activation (CUDA C++,
                     sm_90a), replacing repro/kernels/ibn_conv.py::ibn_pointwise
  flash_attention  — online-softmax GQA attention (CUDA C++, sm_90a),
                     replacing repro/kernels/flash_attention.py::flash_attention
  ssd_scan         — the Mamba2 SSD chunk scan (CUDA C++, sm_90a), replacing
                     repro/kernels/ssd_scan.py::ssd_scan
  gmm              — the grouped per-expert matmul (CUDA C++, sm_90a),
                     replacing repro/kernels/gmm.py::gmm

ops.py is the dispatch the model code calls, ref.py the plain versions,
build.py compiles the CUDA sources.
"""
