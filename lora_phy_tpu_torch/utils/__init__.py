"""Configuration types of the PyTorch port (:mod:`.params`)."""
