"""Host-side data path (numpy only): samples, synthetic data, radius
graphs, splitting, preparation and pad plans."""
