"""The flagship (the port's copy of ``hydragnn_tpu/flagship.py``): a
multi-head PNA stack — one graph energy head and three nodal heads — on
the deterministic BCC dataset, at hidden width 128 with 6 conv layers by
default. ``build_flagship`` returns it ready to train.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


def flagship_config(
    hidden_dim: int = 128,
    num_conv_layers: int = 6,
    batch_size: int = 128,
    num_epoch: int = 1,
) -> Dict[str, Any]:
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "flagship_bench",
            "format": "unit_test",
            "compositional_stratified_splitting": False,
            "rotational_invariance": False,
            "node_features": {
                "name": ["x", "x2", "x3"],
                "dim": [1, 1, 1],
                "column_index": [0, 6, 7],
            },
            "graph_features": {
                "name": ["sum_x_x2_x3"],
                "dim": [1],
                "column_index": [0],
            },
        },
        "NeuralNetwork": {
            "Architecture": {
                "model_type": "PNA",
                "radius": 2.0,
                "max_neighbours": 100,
                "periodic_boundary_conditions": False,
                "hidden_dim": hidden_dim,
                "num_conv_layers": num_conv_layers,
                "output_heads": {
                    "graph": {
                        "num_sharedlayers": 2,
                        "dim_sharedlayers": hidden_dim,
                        "num_headlayers": 2,
                        "dim_headlayers": [hidden_dim, hidden_dim // 2],
                    },
                    "node": {
                        "num_headlayers": 2,
                        "dim_headlayers": [hidden_dim, hidden_dim // 2],
                        "type": "mlp",
                    },
                },
                "task_weights": [4.0, 2.0, 2.0, 2.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0],
                "output_names": ["sum_x_x2_x3", "x", "x2", "x3"],
                "output_index": [0, 0, 1, 2],
                "type": ["graph", "node", "node", "node"],
            },
            "Training": {
                "num_epoch": num_epoch,
                "perc_train": 0.8,
                "loss_function_type": "mse",
                "batch_size": batch_size,
                "Optimizer": {"type": "AdamW", "learning_rate": 1e-3},
            },
        },
    }


def build_flagship(
    n_samples: int = 512,
    hidden_dim: int = 128,
    num_conv_layers: int = 6,
    batch_size: int = 128,
    unit_cells: Tuple[int, int] = (2, 4),
    seed: int = 0,
    edge_multiple: int = 8,
    device: Optional[str] = "cuda",
    edge_lengths: bool = False,
):
    """Returns (config, model, train_loader): the completed flagship
    config, the seeded model on ``device`` and a shuffling, drop-last
    train loader of run-aligned batches. ``edge_lengths`` adds the
    reference's length edge feature (``Architecture.edge_features``,
    edge_dim 1 through every conv)."""
    from hydragnn_tpu_torch.data.ingest import prepare_dataset
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.utils.config import update_config

    config = flagship_config(hidden_dim, num_conv_layers, batch_size)
    if edge_lengths:
        config["NeuralNetwork"]["Architecture"]["edge_features"] = ["lengths"]
    samples = deterministic_graph_data(
        number_configurations=n_samples,
        unit_cell_x_range=unit_cells,
        unit_cell_y_range=unit_cells,
        unit_cell_z_range=unit_cells,
        seed=seed,
    )
    train, val, test, _, _ = prepare_dataset(samples, config)
    config = update_config(config, train, val, test)
    loader = GraphLoader(train, batch_size, shuffle=True, drop_last=True, edge_multiple=edge_multiple)
    model = create_model_config(config["NeuralNetwork"], seed=seed, device=device)
    return config, model, loader
