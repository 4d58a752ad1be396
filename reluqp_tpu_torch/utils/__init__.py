"""Host numpy utilities: problem generators and Ruiz scaling."""
