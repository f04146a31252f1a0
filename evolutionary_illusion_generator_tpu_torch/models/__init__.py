"""Model families: CPPN pattern generators and the PredNet predictive coder."""
