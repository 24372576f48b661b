"""EigenTrajectory in PyTorch for one NVIDIA H100.

The PyTorch counterpart of `eigentrajectory_tpu`. Module names follow the JAX
package so that each part can be found beside its reference; the JAX package
stays the reference every module here is tested against.

Layer map (the training, evaluation and serving paths of ET-STGCNN, ET-SGCN,
ET-DMRGCN, ET-Graph-TERN, ET-GP-Graph-STGCNN, ET-GP-Graph-SGCN and
ET-Social-Implicit, sequenced, and of ET-PECNet, ET-LB-EBM and
ET-AgentFormer, collated):
  config          typed experiment configuration
  data            trajectory windowing (the native C++ preprocessor,
                  `data/native_loader.py`, by default; the Python loader),
                  augmentation, padded scene batches and packed
                  flat-pedestrian batches
  etspace         normalizer / descriptor fit + projection / k-means anchors
                  (one problem or a batch of them) + refine / facade with the
                  training losses and the per-scene centring of packed batches
  models          the predictor registry (stgcnn, sgcn, dmrgcn, graphtern,
                  gpgraphstgcnn, gpgraphsgcn, implicit, pecnet, lbebm,
                  agentformer), and the dormant stochastic modules no
                  pipeline calls (PECNet and LB-EBM CVAEs with the Langevin
                  prior sampler, full Social-Implicit, full Graph-TERN)
  metrics         min-of-S ADE/FDE/TCC/COL with a leading scene axis;
                  scene-masked COL
  ops             hand-written CUDA kernels with their plain PyTorch versions
  interop         flax msgpack checkpoints <-> PyTorch modules and tensors;
                  the reference's .pth checkpoints imported
  train           training + evaluation engine (`ETTorchTrainer`:
                  `init_descriptor()`, `fit()`, `load_model()`, `test()`),
                  data-parallel over `mesh_data_axis` ranks
  inference       serving API (`ETPredictor.predict()`, over a device mesh)
  parallel        device mesh, process group, all-reduce, dry run
  analysis        curve bases, the descriptor evaluation
                  (`python -m eigentrajectory_tpu_torch.analysis.descriptor_evaluation`)
                  and the plots
  utils           step timer, gated profiler spans and trace counters,
                  print_arguments
  trainval        the CLI (`python -m eigentrajectory_tpu_torch.trainval`)

Nothing here imports JAX.
"""

import torch

# The JAX package runs every matmul at "highest" f32 precision
# (eigentrajectory_tpu/train/trainer.py:37-40). On the card a f32 matmul is
# full f32 by default, but a f32 convolution goes through cuDNN in TF32;
# turn both off so the convs of the STGCNN keep f32 accuracy.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
