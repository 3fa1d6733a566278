"""Host-side data path (numpy only): samples, synthetic data, readers
(LSMS, XYZ, CFG, the HGC container, reference pickles, SMILES), radius
graphs, splitting, preparation and pad plans.

The public names are the JAX package's ``hydragnn_tpu.data`` names for
the modules ported so far (the ADIOS reader is not). As there,
``radius_graph`` names the function: reach the module through
``importlib.import_module("hydragnn_tpu_torch.data.radius_graph")``.
"""

from hydragnn_tpu_torch.data.radius_graph import radius_graph, radius_graph_pbc
from hydragnn_tpu_torch.data.dataset import (
    GraphSample,
    normalize_dataset,
    scale_features_by_num_nodes,
    update_predicted_values,
    select_input_features,
    samples_to_graph_dicts,
)
from hydragnn_tpu_torch.data.splitting import split_dataset, compositional_stratified_splitting
from hydragnn_tpu_torch.data.loader import GraphLoader, pad_plan_for
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.data.smiles import (
    generate_graphdata_from_smilestr,
    get_node_attribute_name,
    mol_from_smiles,
    parse_smiles,
)
from hydragnn_tpu_torch.data.atomic_descriptors import atomicdescriptors
from hydragnn_tpu_torch.data.import_reference import (
    ReferenceMonolithicReader,
    ReferencePickleReader,
    import_monolithic_dataset,
    import_pickle_dataset,
)

__all__ = [
    "radius_graph",
    "radius_graph_pbc",
    "GraphSample",
    "normalize_dataset",
    "scale_features_by_num_nodes",
    "update_predicted_values",
    "select_input_features",
    "samples_to_graph_dicts",
    "split_dataset",
    "compositional_stratified_splitting",
    "GraphLoader",
    "pad_plan_for",
    "deterministic_graph_data",
    "generate_graphdata_from_smilestr",
    "get_node_attribute_name",
    "mol_from_smiles",
    "parse_smiles",
    "atomicdescriptors",
    "ReferencePickleReader",
    "import_pickle_dataset",
    "ReferenceMonolithicReader",
    "import_monolithic_dataset",
]
