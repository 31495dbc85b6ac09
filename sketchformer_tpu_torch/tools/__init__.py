"""Tools of the PyTorch port: the reference-weight importer
(``import_reference_weights``) and its TF2 checkpoint reader
(``tf_bundle``), neither of which needs TensorFlow."""
