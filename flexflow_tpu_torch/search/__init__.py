"""The Unity search (twin of `flexflow_tpu/search/`): parallelization and
substitution search over the PCG, priced by a machine model of the mesh.

- the strategy space is per-node mesh-axis assignments (the MachineView
  analog); the executor runs whatever assignment is picked, so the
  search's job is to pick minimum-makespan assignments;
- the simulator's measured kernels become a roofline, calibrated by
  timing the dominant ops on the model's device (on a card, CUDA graphs
  replayed between CUDA events), and its network model becomes the
  machine model of the mesh: NVSwitch and InfiniBand for the H100, the
  torus for the JAX package's TPU chips (machine_model.py);
- GraphXfer rewrites (substitution.py), the DP over sequence splits
  (unity.py), their joint search (joint.py) and the mesh factorization
  search (mesh_search.py) are the JAX package's, so both packages pick
  the identical Strategy on the same graph and machine.
"""

from .cost_model import CostMetrics, CostModel, classify_reshard
from .machine_model import (
    AxisTopology,
    NVSwitchMachineModel,
    TorusMachineModel,
    TPUMachineModel,
    machine_model_for_mesh,
)
from .unity import UnitySearch, mcmc_search_strategy, search_strategy
