"""A run of the benchmark keeps torch's own CPU work to one thread
(``benchmark.run.cache_env``); so do its tests, which also keeps workers
that run side by side from oversubscribing the cores."""

import torch

torch.set_num_threads(1)
