"""Int8 serving engine and the device-resident feature table."""
