"""The CG solver of the LS-SVM dual system."""
