"""pcp_tpu_torch: the PyTorch / CUDA port of pcp_tpu for NVIDIA Hopper GPUs.

The lately-fusion ego CenterPoint and the car and RSU senders: serving
(``entry.build``), training (``train/``), the V2X-Sim data pipeline on the
synthetic world (``datasets/``, with the native host kernels of
``native/``), the exchange database (``exchange/``) and the CLIs
(``python -m pcp_tpu_torch.tools.train`` / ``.tools.test``,
``python -m pcp_tpu_torch.workspace.v2x_gen_exchange_database``,
``pcp_tpu_torch/workspace/synth_experiments.sh``), the bench's serving
modes (``python -m pcp_tpu_torch.bench --bf16 --fold-bn --wpack ...``) and
the ego's data-parallel training (``parallel/``, ``--launcher pytorch``).
Importing the package builds nothing and needs no GPU.
"""
