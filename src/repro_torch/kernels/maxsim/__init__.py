"""MaxSim over f32 token vectors, all-pairs and per-query rerank: ``csrc/maxsim.cu``."""
